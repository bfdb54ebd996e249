"""Command-line drivers of the port, as ``repro.launch``: ``serve`` (batched
prefill + KV-cache decode) and ``train`` (LM split learning through
``SplitSession(engine="llm-split")``)."""
