"""Compare the machine code (SASS) of the Vecchia block kernels of two
dgp_tpu_torch checkouts, function by function, on a machine with the CUDA
toolkit.

    python3 tools/sass_compare.py CHECKOUT_A CHECKOUT_B [--one-row] [--only NAMES]
                                  [--show NAME]

builds each checkout's kernel library in a process of its own (its
`ops.cuda_vecchia.build`, into that checkout's `_build/`), disassembles it
with `cuobjdump -sass`, drops the addresses and encodings, and prints one
JSON object: for every kernel entry point of the two libraries whether its
instructions are the same in both.  With ``--one-row`` only the
instantiations with one row per lane (m1 <= 32) are listed; with ``--only
NAMES`` (comma-separated, e.g. ``block_loglik_multi,cond_weights,
block_loglik_parts`` for K2, K3 and K4) only the functions whose names
contain one of them.  A name present in one library only is reported as
such.  ``--show NAME`` also prints a
unified diff of the instructions of each function whose name contains
NAME.
"""
import difflib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from dgp_tpu_torch.ops import cuda_vecchia as cv; cv.build(); "
          "print(cv.build_info['library'])")


def _cuobjdump():
    for c in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if c and Path(c).is_file():
            return c
    raise SystemExit("cuobjdump not found")


def functions(checkout):
    """{mangled name: [instruction, ...]} of the checkout's library."""
    lib = subprocess.run([sys.executable, "-c", _BUILD, str(checkout)], check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[-1]
    text = subprocess.run([_cuobjdump(), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            cur.append(m.group(1))
    return out


def one_row(name):
    """Whether a kernel's mangled name is an instantiation with one row per
    lane (K2 has a separate entry point for two; K1, K3, K4 a template
    argument R)."""
    if "block_loglik_multi_kernel" in name:
        return "_r2" not in name
    return re.search(r"Li[01]ELi1EE", name) is not None


def main():
    argv = sys.argv[1:]
    show = argv.pop(argv.index("--show") + 1) if "--show" in argv else None
    only = argv.pop(argv.index("--only") + 1).split(",") if "--only" in argv else None
    args = [a for a in argv if not a.startswith("--")]
    rows = "--one-row" in argv
    a, b = (functions(Path(p).resolve()) for p in args[:2])
    names = sorted(set(a) | set(b))
    if rows:
        names = [n for n in names if one_row(n)]
    if only:
        names = [n for n in names if any(o in n for o in only)]
    res = {n: ("only in " + (args[0] if n in a else args[1])) if (n in a) != (n in b)
           else ("same" if a[n] == b[n] else "differs") for n in names}
    for n in names if show else ():
        if show in n and n in a and n in b:
            sys.stdout.writelines(difflib.unified_diff(
                [i + "\n" for i in a[n]], [i + "\n" for i in b[n]], n, n, n=2))
    print(json.dumps({"a": args[0], "b": args[1], "functions": res,
                      "same": sum(v == "same" for v in res.values()),
                      "of": len(res)}), flush=True)


if __name__ == "__main__":
    main()
