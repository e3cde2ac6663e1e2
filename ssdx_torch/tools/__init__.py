"""Measurement and fault-finding tools of the port that run on a GPU."""
