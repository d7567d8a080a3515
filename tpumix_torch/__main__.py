import sys

from tpumix_torch.cli import main

sys.exit(main())
