"""The port's headline benchmark: ``scenes/cornell.json`` (a stand-in for
the reference's file) at 800x800, depth 8, ms/frame on one NVIDIA GPU.

    python bench_torch.py

Prints one JSON line with ``bench.py``'s keys
(``project3_cuda_path_tracer_2025_tpu_torch/bench.py`` says what each
means); without a CUDA device, ``value`` null and an ``error``, exit 1.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from project3_cuda_path_tracer_2025_tpu_torch.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
