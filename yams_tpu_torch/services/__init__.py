"""The service layer on the port's engine, store and indexes: AppContext
and the document, indexing, search, graph, symbol and stats services."""

from .app import AppContext
from .document_service import DocumentService
from .indexing_service import IndexingService
from .search_service import SearchService

__all__ = [
    "AppContext",
    "DocumentService",
    "SearchService",
    "IndexingService",
]
