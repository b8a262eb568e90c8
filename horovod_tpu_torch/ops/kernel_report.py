"""What the compiler made of a ``csrc`` source, per kernel.

Run on a machine with the CUDA toolkit:

    python3 -m horovod_tpu_torch.ops.kernel_report [SOURCE ...]

For each source (default: every one in ``kernels.SOURCES``) it compiles
with the port's own ``NVCC_FLAGS`` plus ``-Xptxas -v`` into a temporary
directory, and prints one JSON line per kernel: its registers, spill
stores and loads, static shared memory (from ``ptxas``), and the count of
each SASS instruction of :data:`OPS` in its body (from ``cuobjdump
-sass``): ``HGMMA`` is a ``wgmma``, ``UTMALDG`` a TMA tile load. A last
line carries ``ptxas``'s warnings, if any.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

from . import kernels

OPS = ("HGMMA", "UTMALDG")

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_SASS_FN = re.compile(r"Function : (\S+)")


def _demangle(names: List[str]) -> Dict[str, str]:
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True)
    if out.returncode != 0:
        return {n: n for n in names}
    return dict(zip(names, out.stdout.splitlines()))


def report(source: str) -> List[dict]:
    """One record per kernel of ``source``."""
    nvcc = kernels._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp, "lib.so")
        proc = subprocess.run(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(kernels._CSRC / source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        recs: Dict[str, dict] = {}
        notes: List[str] = []
        current = None
        for line in proc.stderr.splitlines():
            m = _PTXAS_FN.search(line)
            if m:
                current = recs.setdefault(m.group(1), {"kernel": m.group(1)})
                continue
            if "Performance" in line or "warning" in line:
                notes.append(line.strip())
            if current is None:
                continue
            if (m := _PTXAS_REGS.search(line)):
                current["registers"] = int(m.group(1))
                if (s := _PTXAS_SMEM.search(line)):
                    current["static_smem_bytes"] = int(s.group(1))
            if (m := _PTXAS_SPILL.search(line)):
                current["spill_store_bytes"] = int(m.group(1))
                current["spill_load_bytes"] = int(m.group(2))
        cuobjdump = Path(nvcc).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
    current = None
    for line in sass.splitlines():
        m = _SASS_FN.search(line)
        if m:
            current = recs.setdefault(m.group(1), {"kernel": m.group(1)})
            current.update({op: 0 for op in OPS})
            continue
        if current is not None:
            for op in OPS:
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    names = _demangle(list(recs))
    out = [{"source": source, **rec, "kernel": names[name]}
           for name, rec in recs.items()]
    if notes:
        out.append({"source": source, "ptxas_notes": notes})
    return out


def main(argv=None) -> int:
    sources = (argv if argv is not None else sys.argv[1:]) or \
        list(kernels.SOURCES)
    for source in sources:
        for rec in report(source):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
