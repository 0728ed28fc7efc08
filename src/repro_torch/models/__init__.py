"""The LM of the serving path: layers, attention (prefill through the flash
kernel), mixture-of-experts layers (``moe``), the chunked linear RNN and
Mamba2 (``ssm``), the mLSTM and sLSTM blocks (``xlstm``), the decoder
(``transformer``: the ``attn`` block pattern, dense or MoE, token or
embedding inputs; ``zamba``, Mamba2 with a shared attention block;
``xlstm``; KV-head replication), the weight carry-over from the
reference (``convert``) and the activation layout on a device mesh
(``shardctx``)."""
