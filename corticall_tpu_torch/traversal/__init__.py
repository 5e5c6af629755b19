from .engine import (  # noqa: F401
    TraversalEngine,
    TraversalConfig,
    FORWARD,
    REVERSE,
    BOTH,
    AND,
    OR,
)
from .subgraph import Subgraph, Vertex  # noqa: F401
from .utils import to_contig, to_walk  # noqa: F401
