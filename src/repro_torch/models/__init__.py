"""The LM of the serving path: layers, attention (prefill through the flash
kernel), the decoder (``transformer``) and the weight carry-over from the
reference (``convert``)."""
