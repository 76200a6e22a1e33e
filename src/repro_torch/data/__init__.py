# Copied from src/repro/data/__init__.py; only the imports may differ.
from .pipeline import DataPipeline, SyntheticCorpus
from .packing import pack_documents, packing_efficiency

__all__ = ["DataPipeline", "SyntheticCorpus", "pack_documents",
           "packing_efficiency"]
