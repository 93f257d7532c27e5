"""`python -m gpu_ray_tracing_tpu_torch` entry point."""

import sys

from gpu_ray_tracing_tpu_torch.cli import main

sys.exit(main())
