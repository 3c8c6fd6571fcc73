"""Entry points of the port: the serving loop."""
