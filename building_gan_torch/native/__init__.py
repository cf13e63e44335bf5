"""The host runtime's C++ sources: the building-JSON parser and the server's micro-batcher."""
