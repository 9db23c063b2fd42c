"""Entry points of the port: ``launch.serve``, the multi-tenant serving CLI,
and ``launch.mesh``, the client meshes of sharded aggregation."""
