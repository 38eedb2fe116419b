from . import llql  # noqa: F401
from .cardinality import CardModel, ColumnStats, RelStats  # noqa: F401
from .cost import AnalyticCostModel, DictChoice, infer_cost  # noqa: F401
from .synthesis import synthesize, synthesize_exhaustive  # noqa: F401
