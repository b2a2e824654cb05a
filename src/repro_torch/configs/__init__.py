"""Model and run configurations of the port."""
