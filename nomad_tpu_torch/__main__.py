"""`python -m nomad_tpu_torch` → the CLI (reference main.go:12)."""
import sys

from .cli import main

sys.exit(main())
