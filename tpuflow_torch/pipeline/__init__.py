"""Host-side pipeline: video IO, caching, composition, filename contracts
(the JAX package's pipeline/, with its ops in torch)."""

from .filenames import (
    generate_output_filename,
    generate_output_filepath,
    generate_cache_directory,
)
from .cache import FlowFileHandler, LODGenerator, FlowCacheManager

__all__ = [
    "generate_output_filename",
    "generate_output_filepath",
    "generate_cache_directory",
    "FlowFileHandler",
    "LODGenerator",
    "FlowCacheManager",
]
