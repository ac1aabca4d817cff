#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with each phase line prefixed by the seconds since
the start, to see where the script's time goes.

    python3 tools/torch_timed_smoke.py            # from the repository root
    (cd build/parent && python3 ../../tools/torch_timed_smoke.py)   # another tree

It runs the ``chip_smoke.py`` of the current directory; every line that
starts with ``[`` (but not the ``[build]`` lines) gets ``<seconds>`` in
front.  The script's own output and exit code are unchanged otherwise.
"""

import builtins
import os
import runpy
import sys
import time


def main() -> None:
    t0 = time.perf_counter()
    plain_print = builtins.print

    def stamped(*args, **kw):
        if (args and isinstance(args[0], str) and args[0].startswith("[")
                and not args[0].startswith("[build]")):
            args = (f"<{time.perf_counter() - t0:7.1f}>",) + args
        kw.setdefault("flush", True)
        plain_print(*args, **kw)

    builtins.print = stamped
    here = os.getcwd()
    sys.path.insert(0, here)
    sys.argv = ["chip_smoke.py"]
    runpy.run_path(os.path.join(here, "chip_smoke.py"), run_name="__main__")


if __name__ == "__main__":
    main()
