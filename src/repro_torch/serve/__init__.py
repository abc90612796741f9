"""Serving of the port: the per-site LM slot engine (:mod:`.engine`)."""
