"""Activity / object vocabularies for the VIRAT/ActEV experiments.

The port's copy of ``multiverse_tpu/data/vocab.py``: the same
label -> id assignment as the reference (reference:
code/pred_utils.py:23-67). These are public VIRAT dataset label names;
ids are positional.
"""

_ACTIVITIES = [
    "BG",
    "activity_walking",
    "activity_standing",
    "activity_carrying",
    "activity_gesturing",
    "Closing",
    "Opening",
    "Interacts",
    "Exiting",
    "Entering",
    "Talking",
    "Transport_HeavyCarry",
    "Unloading",
    "Pull",
    "Loading",
    "Open_Trunk",
    "Closing_Trunk",
    "Riding",
    "specialized_texting_phone",
    "Person_Person_Interaction",
    "specialized_talking_phone",
    "activity_running",
    "PickUp",
    "specialized_using_tool",
    "SetDown",
    "activity_crouching",
    "activity_sitting",
    "Object_Transfer",
    "Push",
    "PickUp_Person_Vehicle",
]

_OBJECTS = [
    "Person",
    "Vehicle",
    "Parking_Meter",
    "Construction_Barrier",
    "Door",
    "Push_Pulled_Object",
    "Construction_Vehicle",
    "Prop",
    "Bike",
    "Dumpster",
]

activity2id = {name: i for i, name in enumerate(_ACTIVITIES)}
object2id = {name: i for i, name in enumerate(_OBJECTS)}

# ids of "moving" activities used for trajectory categorisation
# (reference: code/preprocess.py:756-760)
MOVE_ACTIVITY_IDS = (
    activity2id["activity_walking"],
    activity2id["activity_running"],
    activity2id["Riding"],
)
