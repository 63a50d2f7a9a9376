"""The benchmark's plain reference of the SplatCo render and SVC training
step: float32 PyTorch operations with no kernel, cache or batching of the
program's, written after the JAX package's equations (frozen copies of the
port's plain versions where the port has one).  It imports nothing of the
program; it reads the program's outputs only to judge them.

`precision="tf32"` rounds every operand of a matrix product or a
convolution to TF32 (10 mantissa bits) before the float32 product: the
control that a comparison has to reject.
"""
