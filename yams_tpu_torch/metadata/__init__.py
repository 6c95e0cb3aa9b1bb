from .db import Database
from .kg import KnowledgeGraphStore

__all__ = ["Database", "KnowledgeGraphStore"]
