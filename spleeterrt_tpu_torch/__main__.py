import sys

from spleeterrt_tpu_torch.cli import main

sys.exit(main())
