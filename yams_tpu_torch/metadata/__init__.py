from .db import Database
from .kg import KnowledgeGraphStore
from .repository import MetadataRepository
from .tree import TreeBuilder, TreeDiffer

__all__ = ["Database", "MetadataRepository", "KnowledgeGraphStore", "TreeBuilder", "TreeDiffer"]
