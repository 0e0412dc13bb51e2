"""The layers, attention and blocks the stream MLLM is built from."""
