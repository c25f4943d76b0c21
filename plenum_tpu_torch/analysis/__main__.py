"""``python -m plenum_tpu_torch.analysis [paths]``: the port's plenum-lint
(see cli.py for the flags)."""
import sys

from plenum_tpu_torch.analysis.cli import main

sys.exit(main())
