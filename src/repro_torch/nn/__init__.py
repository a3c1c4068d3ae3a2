"""repro_torch.nn — dense decoder layers, attention and the LM facade."""
