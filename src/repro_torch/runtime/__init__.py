"""Token generation: prefill and decode steps, continuous batching."""
