"""Host utilities: TextRank keyphrases, MinHash, the retrieval metrics, BEIR
datasets, the optimizer of the trainers, and the synthetic corpora and
benchmark tracker of the tests (copies of yams_tpu.utils)."""

from .benchtrack import BenchmarkTracker
from .fixtures import SyntheticCorpus, TestDataGenerator

__all__ = ["TestDataGenerator", "SyntheticCorpus", "BenchmarkTracker"]
