"""Command-line entry points mirroring ``ecg_byte_tpu.cli``."""
