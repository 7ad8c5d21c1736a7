"""The DTD tutorial examples: task insertion, VALUE and INOUT arguments,
untied (generator) bodies."""
