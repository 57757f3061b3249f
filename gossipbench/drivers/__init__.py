"""Window drivers, one module per kind of mix, named by a mix's
``driver``."""
