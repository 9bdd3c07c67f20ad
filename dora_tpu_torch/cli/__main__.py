"""``python -m dora_tpu_torch.cli``."""

import sys

if __name__ == "__main__":
    from dora_tpu_torch.cli.main import main

    sys.exit(main())
