"""Recall@K / mR@K evaluation: the host evaluator (`recall`), the scorers on
the card (`recall_device`) and the streaming epoch eval (`epoch`)."""
