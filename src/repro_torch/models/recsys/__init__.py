"""Recsys substrate of the port: embedding tables and bag lookups."""
