"""Host utilities: TextRank keyphrases, MinHash, the retrieval metrics, BEIR
datasets and the optimizer of the trainers."""
