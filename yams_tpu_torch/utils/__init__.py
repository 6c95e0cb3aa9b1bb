"""Host utilities the services run: TextRank keyphrases and MinHash."""
