"""Measurement helpers of the port, run on the card (``knn_bench``)."""
