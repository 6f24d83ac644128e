"""Host-side helpers of the port (copies of the reference's JAX-free
utilities it needs)."""
