"""How a configuration's file becomes the program's model: one module a
model family, named by the file's ``family``."""
