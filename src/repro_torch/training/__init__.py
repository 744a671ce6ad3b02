"""Training: AdamW and the train, prefill and serve step builders."""
