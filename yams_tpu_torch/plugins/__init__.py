from .manager import PluginManager
from .spec import (
    ContentExtractorPlugin,
    EntityExtractorPlugin,
    ModelProviderPlugin,
    PluginManifest,
)

__all__ = [
    "PluginManager",
    "PluginManifest",
    "ModelProviderPlugin",
    "ContentExtractorPlugin",
    "EntityExtractorPlugin",
]
