"""The benchmark's harness: cells, drivers and metric readers found by
name, inputs made from the seed, the program's entry points, the traced
window and the correctness check."""
