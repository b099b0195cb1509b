"""The yardstick: manifest lookup, inputs and weights from the seed, peaks,
FLOP and byte formulas, the profiler reduction and the comparisons."""
