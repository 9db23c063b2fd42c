"""The port's runnable examples, twins of the repository's ``examples/``:
``quickstart``, ``compare_aggregators``, ``fed_finetune_lm`` and
``serve_lora``.  Run them as ``python -m repro_torch.examples.<name>``; each
runs on the card unless ``--device cpu`` is given."""
