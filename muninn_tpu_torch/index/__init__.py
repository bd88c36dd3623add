"""Vector store and indexes."""
