"""Serving steps of the port (``steps``); the training steps come
with ROADMAP A13c."""
