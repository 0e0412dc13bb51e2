"""The paper's 13 queries."""
