"""The LM of the serving path: layers, attention (prefill through the flash
kernel), mixture-of-experts layers (``moe``), the decoder (``transformer``:
the ``attn`` block pattern, dense or MoE, token or embedding inputs) and
the weight carry-over from the reference (``convert``).  The ``xlstm``
and ``zamba`` block patterns still raise ``NotImplementedError``."""
