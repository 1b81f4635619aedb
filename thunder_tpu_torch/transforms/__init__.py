"""Trace transforms of the port: autodiff, autocast (and autocast_ctx),
remat, quantization (int8, NF4), fp8 training and inference, LoRA,
constant folding, prologue pruning and meta materialization."""
