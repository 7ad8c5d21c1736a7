"""Plain PyTorch references of the port's model configurations, one file
each, importing torch alone: the tests hold the program against them, and
nothing in the program imports them."""
