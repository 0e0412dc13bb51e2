"""The stream processor: operators, plans, the runtime and the MLLM."""
