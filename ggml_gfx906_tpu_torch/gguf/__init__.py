"""GGUF container reader and writer (numpy)."""
from .format import GGUFReader, GGUFWriter, GGUFValueType, TensorInfo  # noqa: F401
