"""Launchers of the port: the LM token server (``serve``) and the trainer
(``train``)."""
