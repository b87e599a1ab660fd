"""`python -m gridmap_slam_tpu_torch.bench`: see run.py."""

import sys

from .run import main

sys.exit(main())
