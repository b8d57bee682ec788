"""The port's counterparts of ``__graft_entry__.py``: ``entry()`` and
``dryrun_multichip()`` (``project3_cuda_path_tracer_2025_tpu_torch/entry.py``).

    python graft_entry_torch.py          # entry() on the card, then every dry-run tag
    NDEV=8 python graft_entry_torch.py   # 8 shards (default 4) over the cards there are
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from project3_cuda_path_tracer_2025_tpu_torch.entry import (  # noqa: E402,F401
    dryrun_multichip, entry, main,
)

if __name__ == "__main__":
    sys.exit(main())
