"""Benchmark corpora."""

from hydragen_torch.data.haystack import Needle, make_needle_haystack

__all__ = ["Needle", "make_needle_haystack"]
