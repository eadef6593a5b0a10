"""Protocol core of the port: similarity, engines, one-shot clustering."""
