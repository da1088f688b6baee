"""``python -m pllmod_tpu_torch`` — the port's command line
(:mod:`pllmod_tpu_torch.cli`)."""

import sys

from pllmod_tpu_torch.cli import main

sys.exit(main())
