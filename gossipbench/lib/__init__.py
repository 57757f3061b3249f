"""The benchmark's yardstick: seeds, weights, counts, the trace and the
comparison. Imports nothing of the program."""
