"""Parameter-tree utilities of the port."""
