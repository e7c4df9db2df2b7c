"""The data plane: the quote-aware CSV row index, the ``b1`` binary wire,
the staging pool and the ``output_uri`` result sink."""
