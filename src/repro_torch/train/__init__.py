"""Training and serving steps of the port (``steps``), AdamW (``optim``)
and gradient compression (``compress``)."""
