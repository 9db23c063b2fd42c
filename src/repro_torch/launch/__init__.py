"""Entry points of the port: ``launch.serve``, the multi-tenant serving CLI,
``launch.train``, the federated LoRA fine-tuning CLI (its round halves in
``launch.steps``), and ``launch.mesh``, the client meshes of sharded
aggregation."""
