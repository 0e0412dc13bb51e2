"""Configurations the port runs (the stream MLLM backbones)."""
