"""Head and vocabulary padding (copied from the reference's sharding)."""
