"""Launchers of the port: the LM token server (``serve``), the trainer
(``train``), the device meshes (``mesh``), the sharding plans
(``shardings``) and the mesh planner's dry run (``dryrun``)."""
