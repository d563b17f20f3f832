import sys

from lsafw_tpu_torch.cli import main

sys.exit(main())
