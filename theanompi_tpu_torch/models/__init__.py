"""Model zoo of the port: AlexNet so far."""
