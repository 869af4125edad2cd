"""Device memory: the semaphore and the spill catalog."""
