"""Launchers of the port: the LM token server (``serve``)."""
