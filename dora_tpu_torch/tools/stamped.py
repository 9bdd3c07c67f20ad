"""Run a command and print each line of its standard output prefixed with
the seconds since the command started, so that a long script's phases can
be timed from its log without editing it::

    python3 dora_tpu_torch/tools/stamped.py -- python3 chip_smoke.py

Standard error passes through unchanged; the exit code is the command's.
The file imports nothing of the package and runs from any directory.
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if not argv:
        raise SystemExit("usage: stamped.py -- <command> [args...]")
    t0 = time.monotonic()
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, bufsize=1) as proc:
        for line in proc.stdout:
            sys.stdout.write(f"[{time.monotonic() - t0:8.1f}] {line}")
            sys.stdout.flush()
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
