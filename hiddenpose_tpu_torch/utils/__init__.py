"""Weight bridge from the JAX package, and seeded test weights."""
