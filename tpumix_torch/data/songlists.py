"""Curated songlist registry: a copy of tpumix/data/songlists.py (data
parity with reference data/songlists.py), which the port does not import.

The song-name constants themselves are dataset facts (MedleyDB / MUSDB18-HQ
track identifiers) — they must match the reference registry verbatim for
split/eval parity (SURVEY.md §2.1).  The organisation here is a keyed registry
with metadata and accessors instead of loose module globals; module-level
aliases keep the reference names importable.

Registry keys:
  medleydb_exclude                  — MedleyDB songs excluded from training
                                      (classical / too few stems / trivial)
  medleydb_weathervane_music        — 25 Weathervane Music sessions
  medleydb_independent              — 30 independent-artist sessions
  musdb18_train_not_in_medleydb     — 55 MUSDB18-HQ train songs disjoint from MedleyDB
  musdb18_test                      — 50 MUSDB18-HQ test songs
  musdb18_test_manually_gain_mixed  — 8 songs with human reference gain mixes
  not_in_musdb18                    — MedleyDB songs absent from MUSDB18
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_REGISTRY: Dict[str, Tuple[str, ...]] = {}


def _register(name: str, songs: List[str]) -> Tuple[str, ...]:
    t = tuple(songs)
    _REGISTRY[name] = t
    return t


def get_songlist(name: str) -> List[str]:
    """Fetch a registered songlist by key (returns a fresh list — unlike the
    reference, callers can never mutate the registry by accident; cf. the
    in-place ``random.shuffle`` hazard at reference data/dataset.py:50-52)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown songlist {name!r}; have {sorted(_REGISTRY)}")
    return list(_REGISTRY[name])


def available_songlists() -> List[str]:
    return sorted(_REGISTRY)


# --- MedleyDB ---------------------------------------------------------------

medleydb_exclude = _register("medleydb_exclude", [
    "AmarLal_Rest", "AmarLal_SpringDay1",
    "BrandonWebster_DontHearAThing", "BrandonWebster_YesSirICanFly",
    "ClaraBerryAndWooldog_TheBadGuys",
    "Debussy_LenfantProdigue",
    "EthanHein_1930sSynthAndUprightBass", "EthanHein_BluesForNofi",
    "EthanHein_GirlOnABridge", "EthanHein_HarmonicaFigure",
    "Handel_TornamiAVagheggiar",
    "JoelHelander_Definition", "JoelHelander_ExcessiveResistancetoChange",
    "JoelHelander_IntheAtticBedroom",
    "LizNelson_Coldwar", "LizNelson_ImComingHome", "LizNelson_Rainfall",
    "MatthewEntwistle_AnEveningWithOliver", "MatthewEntwistle_FairerHopes",
    "MatthewEntwistle_ImpressionsOfSaturn", "MatthewEntwistle_Lontano",
    "MatthewEntwistle_TheArch", "MatthewEntwistle_TheFlaxenField",
    "MichaelKropf_AllGoodThings",
    "Mozart_BesterJungling", "Mozart_DiesBildnis",
    "MusicDelta_Beethoven",
    "MusicDelta_ChineseChaoZhou", "MusicDelta_ChineseDrama",
    "MusicDelta_ChineseHenan", "MusicDelta_ChineseJiangNan",
    "MusicDelta_ChineseXinJing", "MusicDelta_ChineseYaoZu",
    "MusicDelta_GriegTrolltog", "MusicDelta_InTheHalloftheMountainKing",
    "MusicDelta_Pachelbel", "MusicDelta_Vivaldi",
    "Phoenix_BrokenPledgeChicagoReel", "Phoenix_ColliersDaughter",
    "Phoenix_ElzicsFarewell", "Phoenix_LarkOnTheStrandDrummondCastle",
    "Phoenix_ScotchMorris", "Phoenix_SeanCaughlinsTheScartaglen",
    "Schubert_Erstarrung", "Schumann_Mignon",
    "TablaBreakbeatScience_Animoog", "TablaBreakbeatScience_CaptainSky",
    "TablaBreakbeatScience_MiloVsMongo", "TablaBreakbeatScience_MoodyPlucks",
    "TablaBreakbeatScience_PhaseTransition", "TablaBreakbeatScience_RockSteady",
    "TablaBreakbeatScience_Scorpio", "TablaBreakbeatScience_Vger",
    "TablaBreakbeatScience_WhoIsIt",
    "Wolf_DieBekherte",
])

medleydb_weathervane_music = _register("medleydb_weathervane_music", [
    "AClassicEducation_NightOwl", "Auctioneer_OurFutureFaces",
    "AvaLuna_Waterduct", "BigTroubles_Phantom", "CelestialShore_DieForUs",
    "Lushlife_ToynbeeSuite", "NightPanther_Fire", "PortStWillow_StayEven",
    "PurlingHiss_Lolita", "SecretMountains_HighHorse", "Snowmine_Curfews",
    "TheSoSoGlos_Emergency", "Creepoid_OldTree",
    "DreamersOfTheGhetto_HeavyLove", "FacesOnFilm_WaitingForGa",
    "FamilyBand_Again", "Grants_PunchDrunk", "HeladoNegro_MitadDelMundo",
    "HezekiahJones_BorrowedHeart", "HopAlong_SisterCities",
    "InvisibleFamiliars_DisturbingWildlife", "StevenClark_Bounty",
    "StrandOfOaks_Spacestation", "SweetLights_YouLetMeDown",
    "TheDistricts_Vermont",
])

medleydb_independent = _register("medleydb_independent", [
    "AimeeNorwich_Child", "AimeeNorwich_Flying",
    "AlexanderRoss_GoodbyeBolero", "AlexanderRoss_VelvetCurtain",
    "AmarLal_Rest", "AmarLal_SpringDay1",
    "MatthewEntwistle_AnEveningWithOliver", "MatthewEntwistle_DontYouEver",
    "MatthewEntwistle_FairerHopes", "MatthewEntwistle_ImpressionsOfSaturn",
    "MatthewEntwistle_Lontano", "MatthewEntwistle_TheArch",
    "MatthewEntwistle_TheFlaxenField",
    "Meaxic_TakeAStep", "Meaxic_YouListen",
    "ClaraBerryAndWooldog_WaltzForMyVictims",
    "CroqueMadame_Oil", "CroqueMadame_Pilot",
    "EthanHein_1930sSynthAndUprightBass", "EthanHein_BluesForNofi",
    "EthanHein_GirlOnABridge", "EthanHein_HarmonicaFigure",
    "TheScarletBrand_LesFleursDuMal",
    "ClaraBerryAndWooldog_AirTraffic", "ClaraBerryAndWooldog_Boys",
    "ClaraBerryAndWooldog_Stella", "ClaraBerryAndWooldog_TheBadGuys",
    "JoelHelander_Definition", "JoelHelander_ExcessiveResistancetoChange",
    "JoelHelander_IntheAtticBedroom",
])

not_in_musdb18 = _register("not_in_musdb18", [
    "AimeeNorwich_Flying", "ChrisJacoby_BoothShotLincoln",
    "ChrisJacoby_PigsFoot", "ClaraBerryAndWooldog_Boys",
    "CroqueMadame_Oil", "CroqueMadame_Pilot", "FamilyBand_Again",
    "KarimDouaidy_Hopscotch", "KarimDouaidy_Yatora",
    "MusicDelta_BebopJazz", "MusicDelta_CoolJazz", "MusicDelta_FreeJazz",
    "MusicDelta_FunkJazz", "MusicDelta_FusionJazz", "MusicDelta_LatinJazz",
    "MusicDelta_ModalJazz", "MusicDelta_Shadows", "MusicDelta_SpeedMetal",
    "MusicDelta_SwingJazz", "MusicDelta_Zeppelin", "PurlingHiss_Lolita",
])

# --- MUSDB18-HQ -------------------------------------------------------------

musdb18_train_not_in_medleydb = _register("musdb18_train_not_in_medleydb", [
    "Actions - Devil's Words", "Actions - One Minute Smile",
    "Actions - South Of The Water", "Angela Thomas Wade - Milk Cow Blues",
    "ANiMAL - Clinic A", "ANiMAL - Easy Tiger", "ANiMAL - Rockshow",
    "Atlantis Bound - It Was My Fault For Waiting",
    "Bill Chudziak - Children Of No-one", "Black Bloc - If You Want Success",
    "Chris Durban - Celebrate", "Cnoc An Tursa - Bannockburn",
    "Dark Ride - Burning Bridges", "Drumtracks - Ghost Bitch",
    "Fergessen - Back From The Start", "Fergessen - Nos Palpitants",
    "Fergessen - The Wind", "Flags - 54", "Giselle - Moss",
    "Grants - PunchDrunk", "Hollow Ground - Left Blind",
    "James May - All Souls Moon", "James May - Dont Let Go",
    "James May - If You Say", "James May - On The Line",
    "Jay Menon - Through My Eyes", "Johnny Lokke - Promises & Lies",
    "Johnny Lokke - Whisper To A Scream",
    "Jokers, Jacks & Kings - Sea Of Leaves", "Leaf - Come Around",
    "Leaf - Summerghost", "Leaf - Wicked", "North To Alaska - All The Same",
    "Patrick Talbot - A Reason To Leave", "Patrick Talbot - Set Me Free",
    "Phre The Eon - Everybody's Falling Apart",
    "Remember December - C U Next Time", "Skelpolu - Human Mistakes",
    "Skelpolu - Together Alone", "Spike Mullings - Mike's Sulking",
    "St Vitus - Word Gets Around", "Swinging Steaks - Lost My Way",
    "The Long Wait - Back Home To Blue", "The Wrong'Uns - Rothko",
    "Tim Taler - Stalker", "Titanium - Haunted Age",
    "Traffic Experiment - Once More (With Feeling)",
    "Traffic Experiment - Sirens", "Triviul - Angelsaint",
    "Triviul - Dorothy", "Voelund - Comfort Lives In Belief",
    "Wall Of Death - Femme", "Young Griffo - Blood To Bone",
    "Young Griffo - Facade", "Young Griffo - Pennies",
])

musdb18_test = _register("musdb18_test", [
    "Al James - Schoolboy Facination", "AM Contra - Heart Peripheral",
    "Angels In Amplifiers - I'm Alright", "Arise - Run Run Run",
    "Ben Carrigan - We'll Talk About It All Tonight",
    "BKS - Bulldozer", "BKS - Too Much", "Bobby Nobody - Stitch Up",
    "Buitraker - Revo X", "Carlos Gonzalez - A Place For Us",
    "Cristina Vane - So Easy", "Detsky Sad - Walkie Talkie",
    "Enda Reilly - Cur An Long Ag Seol", "Forkupines - Semantics",
    "Georgia Wonder - Siren", "Girls Under Glass - We Feel Alright",
    "Hollow Ground - Ill Fate",
    "James Elder & Mark M Thompson - The English Actor",
    "Juliet's Rescue - Heartbeats", "Little Chicago's Finest - My Own",
    "Louis Cressy Band - Good Time", "Lyndsey Ollard - Catching Up",
    "M.E.R.C. Music - Knockout", "Moosmusic - Big Dummy Shake",
    "Motor Tapes - Shore", "Mu - Too Bright", "Nerve 9 - Pray For The Rain",
    "PR - Happy Daze", "PR - Oh No", "Punkdisco - Oral Hygiene",
    "Raft Monk - Tiring", "Sambasevam Shanmugam - Kaathaadi",
    "Secretariat - Borderline", "Secretariat - Over The Top",
    "Side Effects Project - Sing With Me",
    "Signe Jakobsen - What Have You Done To Me", "Skelpolu - Resurrection",
    "Speak Softly - Broken Man", "Speak Softly - Like Horses",
    "The Doppler Shift - Atrophy", "The Easton Ellises (Baumi) - SDRNR",
    "The Easton Ellises - Falcon 69", "The Long Wait - Dark Horses",
    "The Mountaineering Club - Mallory",
    "The Sunshine Garcia Band - For I Am The Moon", "Timboz - Pony",
    "Tom McKenzie - Directions", "Triviul feat. The Fiend - Widow",
    "We Fell From The Sky - Not You", "Zeno - Signs",
])

musdb18_test_manually_gain_mixed = _register("musdb18_test_manually_gain_mixed", [
    "Arise - Run Run Run", "BKS - Bulldozer", "Cristina Vane - So Easy",
    "Enda Reilly - Cur An Long Ag Seol", "Forkupines - Semantics",
    "Signe Jakobsen - What Have You Done To Me",
    "The Doppler Shift - Atrophy",
    "Meaxic_YouListen",
])
