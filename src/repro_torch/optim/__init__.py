"""AdamW on trees of tensors (``adamw.update``)."""
