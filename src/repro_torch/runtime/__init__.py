"""The port's runtime: checkpoint and restart (``checkpoint``), the elastic
re-mesh after losing devices (``elastic``) and straggler detection
(``stragglers``)."""
