"""AdamW and int8 gradient compression for the training path."""
