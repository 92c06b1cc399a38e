"""One module a model family: everything the harness knows of the family.

``bench/families/<family>.py``, found by a configuration's
``model["family"]`` (``harness.spec.load_cell``), beside its plain
reference ``bench/reference/<family>.py``.  Each module gives, from the
configuration file's ``model`` section ``m`` alone:

- ``config(m)``: the port's ``ModelConfig``, nested sections built too;
- ``leaves(m)``: every weight leaf (name, shape, dtype, init kind) in the
  port's parameter tree, in the order they are drawn (``harness.weights``);
- ``attention_layers(m)``: attention applications per token;
- ``matmul_weights(m)``: the weights one token is multiplied by;
- ``prefill_attention_flops(m, S)`` and ``decode_attention_flops(m,
  cur)``: attention FLOPs of a causal prefill of ``S`` tokens and of one
  decode at position ``cur``, over every attention application;
- ``k1_work(m, contexts, slots)`` and ``k2_work(m, S)``: (FLOPs, bytes)
  of the decode and prefill attention kernels (``metrics/k1_roofline``,
  ``metrics/k2_roofline``), the q/k and v head widths the family's own.

The metric readers and the harness call these and branch on no family
name, so a new family enters as new files only.
"""
