from .base import EMPTY, PAD, HashTable, SortedTable, next_pow2  # noqa: F401
from .registry import family, get, names, register  # noqa: F401
