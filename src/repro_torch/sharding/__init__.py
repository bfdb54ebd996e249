"""Sharding of the port, as ``repro.sharding``: logical-axis annotations
(``logical``), the placement rules of parameter, state and batch trees
(``specs``), the collectives the engines run over a mesh axis
(``collectives``) and the trunk's tensor parallelism (``tensor_parallel``)."""
