"""The port's data pipeline (``pipeline``): the synthetic token stream, its
data-quality masking and the prefetcher."""
