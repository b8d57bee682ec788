"""The SASS of the prim and mesh kernels of this checkout against another's.

    python3 scripts/torch_sass_diff.py --against <checkout> [--out <dir>]

Builds ``csrc/fused_prim.cu`` and ``csrc/fused_mesh.cu`` of both checkouts
for sm_90a with the port's nvcc flags (``ops/kernels.py::NVCC_FLAGS``, a
cubin in place of the shared library), disassembles each with ``cuobjdump
-sass``, and pairs the instantiations of ``KERNELS`` by kernel and
template arguments (the counting argument that this checkout's
``ptt_iteration_kernel`` may add, ``false`` or, as cu++filt writes it,
``(bool)0``, left out of the pairing).  For
each pair it prints whether the instructions are identical once the
addresses and the functions' names are stripped (with and without the
encodings, which carry the scheduling bits), and ptxas's registers, stack
frame and spills on both sides.  An instantiation on one side only is
listed as such.  ``--out`` keeps each side's normalised SASS.  Exit 1 where
a pair differs in its instructions and in its resources, else 0.  Needs
``nvcc``, ``cuobjdump`` and ``cu++filt`` (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels  # noqa: E402

PKG = "project3_cuda_path_tracer_2025_tpu_torch"
SOURCES = ("fused_prim.cu", "fused_mesh.cu")
KERNELS = ("ptt_iteration_kernel", "ptt_bounce_kernel", "ptt_mesh_shade_kernel",
           "ptt_mesh_prelude_kernel")
CUBIN_FLAGS = tuple(f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC"))


def _tool(name: str) -> str:
    return str(pathlib.Path(kernels._nvcc()).with_name(name))


def _demangle(names: list) -> dict:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _key(demangled: str):
    """(kernel, template arguments) of a kernel's demangled name, the
    counting argument ``false`` left out; None for other functions."""
    m = re.match(r"(?:void )?(\w+)(?:<([^>]*)>)?\(", demangled)
    if m is None or m.group(1) not in KERNELS:
        return None
    args = [a.strip() for a in (m.group(2) or "").split(",") if a.strip()]
    if m.group(1) == "ptt_iteration_kernel" and len(args) == 3 and args[2] in ("false",
                                                                                "(bool)0"):
        args = args[:2]
    return m.group(1), tuple(args)


def build(csrc: pathlib.Path, work: pathlib.Path) -> dict:
    """key -> {"text": [...], "encoded": [...], "resources": str} of one
    checkout's kernels."""
    found = {}
    for src in SOURCES:
        cubin = work / (src + ".cubin")
        proc = subprocess.run([kernels._nvcc(), *CUBIN_FLAGS, "-cubin", "-I", str(csrc),
                               "-o", str(cubin), str(csrc / src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{proc.stdout}{proc.stderr}")
        resources = _ptxas_resources(proc.stdout + proc.stderr)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                              text=True, check=True).stdout
        functions = _split_functions(sass)
        names = _demangle(list(functions))
        for mangled, lines in functions.items():
            key = _key(names[mangled])
            if key is None:
                continue
            text, encoded = _normalise(lines, list(functions))
            found[key] = {"text": text, "encoded": encoded, "name": names[mangled],
                          "resources": resources.get(mangled, "not reported")}
    return found


def _split_functions(sass: str) -> dict:
    """mangled name -> the SASS lines of its body."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            out[current] = []
        elif current is not None:
            out[current].append(line)
    return out


def _normalise(lines: list, names: list) -> tuple:
    """(instructions without addresses, encodings and names; the same with
    the encodings)."""
    text, encoded = [], []
    for line in lines:
        line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        for name in names:
            line = line.replace(name, "<fn>")
        enc = re.findall(r"/\* (0x[0-9a-f]+) \*/", line)
        body = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line).strip().rstrip(";").strip()
        if body and not body.startswith(("....", ".", "-")):
            text.append(re.sub(r"\s+", " ", body))
        encoded.append(" ".join([re.sub(r"\s+", " ", body)] + enc))
    return text, [e for e in encoded if e.strip()]


def _ptxas_resources(log: str) -> dict:
    """mangled name -> "R registers, S bytes stack frame, ... spill loads"."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[current] = out.get(current, "") + (f", {m.group(1)} B stack, {m.group(2)} B "
                                                   f"spill stores, {m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current] = f"{m.group(1)} registers" + out.get(current, "")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, help="root of the other checkout")
    ap.add_argument("--out", default=None, help="directory for each side's normalised SASS")
    args = ap.parse_args(argv)
    other = pathlib.Path(args.against).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "this").mkdir()
        (tmp / "other").mkdir()
        this = build(ROOT / PKG / "csrc", tmp / "this")
        that = build(other / PKG / "csrc", tmp / "other")
    out = pathlib.Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    bad = 0
    for key in sorted(set(this) | set(that)):
        label = f"{key[0]}<{', '.join(key[1])}>"
        if key not in that or key not in this:
            side = this if key in this else that
            print(f"{label}: only in {'this checkout' if key in this else args.against} "
                  f"({side[key]['name']}; {side[key]['resources']})")
            continue
        a, b = this[key], that[key]
        same_text, same_enc = a["text"] == b["text"], a["encoded"] == b["encoded"]
        same_res = a["resources"] == b["resources"]
        print(f"{label}: SASS {'identical' if same_enc else 'differs'} with the encodings, "
              f"{'identical' if same_text else 'differs'} without ({len(a['text'])} and "
              f"{len(b['text'])} instructions); ptxas this {a['resources']}, other "
              f"{b['resources']}")
        if out is not None:
            stem = re.sub(r"\W+", "_", label).strip("_")
            (out / f"{stem}.this.sass").write_text("\n".join(a["encoded"]) + "\n")
            (out / f"{stem}.other.sass").write_text("\n".join(b["encoded"]) + "\n")
        bad += not same_text and not same_res
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
