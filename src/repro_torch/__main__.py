"""``python -m repro_torch`` — unified CLI of the port (see :mod:`repro_torch.cli`)."""
import sys

from .cli import main

sys.exit(main())
