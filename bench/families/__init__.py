"""Architecture families: everything of an architecture that the harness
needs, one module a family, found by the ``"family"`` key of a
configuration file (``bench/families/<family>.py``, loaded by path by
``harness/registry.py``).  A new architecture comes as a new module here,
and no file of the harness changes.

A family module gives:

* ``port_fields(config)``: the port's ``ModelConfig`` fields that the
  configuration file sets, ``dtype`` among them (``harness/runner.py::
  port_config`` adds the harness's own: ``param_dtype`` equal to
  ``dtype``, the hand-written kernels on, dropless MoE dispatch);
* ``sizes_of(config)``: the sizes that the weights, the reference and the
  counts read.  The harness itself reads ``vocab_size`` and ``dtype`` (the
  served type), and for the flash decode bound ``num_heads``,
  ``num_kv_heads`` and ``head_dim`` of the attention layers;
* ``leaf_specs(sizes)``: the weight tree, ``(path, shape, dtype name or
  None for the served type, mean, std)`` a leaf, in the order that
  ``harness/weights.py`` draws them (an ``int`` in a path indexes a list);
* ``forward_logits(weights, sizes, seqs, first_rows, quant=None)``: the
  plain reference, fp32 torch only with TF32 off, and with
  ``quant="fp8"`` the comparison's control.  It is defined under
  ``bench/reference/``, whose files import nothing but torch and the
  standard library, and a family module imports nothing of the program
  (``repro_torch``), so that ``correct`` never rests on the program's code;
* ``chunk_flops(sizes, start, n)``, ``decode_flops(sizes, positions)``:
  the model FLOPs of a prefill chunk (a whole prompt is the chunk at
  position 0) and of a decode step, which ``step_mfu`` reads;
* ``attention_layers(sizes)``: how many layers a decode step sends through
  flash attention's ``split`` route.

A family module is loaded by path, not as a package member: it imports
the rest of the benchmark by absolute names (``from bench.<module> import``).
"""
