"""Command-line drivers of the port, as ``repro.launch``: ``serve`` (batched
prefill + KV-cache decode), ``train`` (LM split learning through
``SplitSession(engine="llm-split")``), the meshes (``mesh``), the step of
every (arch x shape x grid) (``steps``) and the ``dryrun`` that traces it."""
