"""Deployment configurations the port runs (the MCGI datasets)."""
