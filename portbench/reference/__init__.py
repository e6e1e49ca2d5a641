"""The plain float32 reference the benchmark judges the port's outputs by.
It imports nothing of the program (``hydragen_torch``) nor of the JAX
package."""

from portbench.reference.llama import Reference

__all__ = ["Reference"]
