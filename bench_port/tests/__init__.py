"""CPU tests of the benchmark (``-m gpu``: the card-only ones)."""
