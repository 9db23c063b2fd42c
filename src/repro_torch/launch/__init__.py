"""Entry points of the port: ``launch.serve``, the multi-tenant serving CLI."""
