"""AdamW with exact in-place rollback, and optimizer post-validation."""
