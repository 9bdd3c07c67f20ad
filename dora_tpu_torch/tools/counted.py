"""Run a module as a dataflow node and write, when it ends, the launches of
the hand-written kernels and the calls of their plain versions over its
whole run (``tools/_common.KernelCounters``) to a JSON file, so a process
that drives the node through a daemon can hold it to the kernels it must
launch::

    - id: vlm
      path: module:dora_tpu_torch.tools.counted
      args: vlm.launches.json dora_tpu_torch.runtime --operator op=...

The module runs as ``python -m <module> <args>`` would run it; the file is
``{"launches": {kernel: n}, "plain_calls": n, "exit": code}``.
"""

from __future__ import annotations

import json
import runpy
import sys


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m dora_tpu_torch.tools.counted <out.json> <module> "
                         "[args...]")
    out, module, rest = argv[0], argv[1], argv[2:]
    from dora_tpu_torch.tools._common import KernelCounters

    code = 0
    with KernelCounters() as counters:
        sys.argv = [module] + rest
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        except BaseException:
            code = 1
            raise
        finally:
            with open(out, "w") as f:
                json.dump({**counters.report(), "exit": code}, f)
    return code


if __name__ == "__main__":
    sys.exit(main())
