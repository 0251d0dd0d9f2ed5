"""Bit-plane layout, quantization, BSDP math and the residency registries."""
