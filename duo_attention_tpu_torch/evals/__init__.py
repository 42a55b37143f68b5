"""Benchmarks and evaluations of the port (counterpart of duo_attention_tpu/evals/)."""
