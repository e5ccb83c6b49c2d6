"""Core truss-decomposition system of the port: graph, supports, peel
engines and the I/O-efficient drivers."""
