import sys

from poi_tpu_torch.cli import main

sys.exit(main())
