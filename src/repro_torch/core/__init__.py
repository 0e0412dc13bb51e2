"""The super-optimizer: semantic, logical and physical phases, the cost
catalog and the orchestrator."""
