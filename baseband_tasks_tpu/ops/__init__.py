"""Device op library shared by tasks and models: the fold accumulation
and on-device bit unpacking."""

from .fold import fold_accumulate

__all__ = ["fold_accumulate"]
