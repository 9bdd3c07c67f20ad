"""``python -m dora_tpu_torch.runtime``: the port's operator runtime node."""

import sys


def main() -> None:
    from dora_tpu_torch.runtime import run

    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
